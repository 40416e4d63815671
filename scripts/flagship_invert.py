"""Inverse rendering at reference-workload scale: recover the flagship
bedroom's emitter radiance and material albedos from a target image by
Adam over the PRODUCTION fwd+bwd path — pipelined record (film as free
byproduct) + sorted adjoint-only replay at the bedroom's actual depth-65
spec (/root/reference/data/bedroom/scene.xml:6).  The adjoint workload
the reference exercises through mi.render's backward
(/root/reference/path.py:332-359), at full frame scale on one chip.

Usage: python scripts/flagship_invert.py [steps] [depth]
Writes out/flagship_invert.json + start/final PNGs.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "out")
sys.path.insert(0, REPO)

import jax

from mitsuba3_experiments_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np
import optax

from mitsuba3_experiments_tpu.integrators.pipelined import (
    record_full_pipelined,
    render_pipelined,
)
from mitsuba3_experiments_tpu.integrators.replay import replay_grads
from mitsuba3_experiments_tpu.render import film as filmlib
from mitsuba3_experiments_tpu.scene.flagship import load_flagship
from mitsuba3_experiments_tpu.scene.params import update
from mitsuba3_experiments_tpu.utils import write_png


def update_log(scene, p):
    """update() with emitter radiance in LOG space: Adam's per-coordinate
    steps are unit-scale, so raw radiance (magnitude ~30) would recover at
    lr units per step; log-parametrization makes the recovery
    multiplicative.  Module-level so replay_grads' static update_fn stays
    one function object across steps (no recompiles)."""
    return update(scene, {
        "emitters.radiance": jnp.exp(p["log_radiance"]),
        "materials.base_color": p["materials.base_color"],
    })


def main():
    os.makedirs(OUT, exist_ok=True)
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else 65
    w, h, spp = 1280, 720, 4
    scene, _ = load_flagship(res=(w, h), spp=spp, tri_budget=2_000_000)
    n_rays = w * h * spp
    chunk = 131072
    pad = ((n_rays + chunk - 1) // chunk) * chunk
    rkw = dict(spp=spp, max_depth=depth, rr_depth=4, steps=48,
               rounds_per_launch=32, n_lanes=65536, pad_to=pad,
               return_film=True, rfilter="box")

    true_rad = np.asarray(scene.emitters.radiance)
    true_col = np.asarray(scene.materials.base_color)

    target = jnp.asarray(np.asarray(render_pipelined(
        scene, seed=0, spp=spp, max_depth=depth, rr_depth=4,
        rfilter="box", n_lanes=65536, steps=48, rounds_per_launch=32,
    )))

    params = {
        "log_radiance": jnp.log(jnp.maximum(
            scene.emitters.radiance * 0.3, 1e-6)),
        "materials.base_color": jnp.clip(
            scene.materials.base_color * 0.5 + 0.25, 0.0, 1.0),
    }
    opt = optax.adam(8e-2)
    opt_state = opt.init(params)

    curve = []
    t_all = time.perf_counter()
    for it in range(n_steps):
        t0 = time.perf_counter()
        scene_it = update_log(scene, params)
        rec, film = record_full_pipelined(scene_it, it + 1, n_rays, **rkw)
        img = filmlib.develop(film)
        loss = float(jnp.mean((img - target) ** 2))
        if it == 0:
            write_png(os.path.join(OUT, "flagship_invert_start.png"),
                      np.asarray(img))
        g = replay_grads(
            scene_it, params, update_log, target, it + 1, rec, n_rays,
            chunk=chunk, spp=spp, max_depth=depth, rr_depth=4,
            rfilter="box", mode="auto", film=film,
        )
        del rec, film
        upd, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, upd)
        params["materials.base_color"] = jnp.clip(
            params["materials.base_color"], 0.0, 1.0)
        dt = time.perf_counter() - t0
        rad_err = float(np.abs(
            np.exp(np.asarray(params["log_radiance"])) - true_rad).mean())
        col_err = float(np.abs(
            np.asarray(params["materials.base_color"]) - true_col).mean())
        curve.append({"it": it, "loss": loss, "rad_err": rad_err,
                      "col_err": col_err, "s": dt})
        print(f"it {it}: loss={loss:.3e} rad_err={rad_err:.4f} "
              f"col_err={col_err:.4f} ({dt:.1f}s)", flush=True)

    scene_f = update_log(scene, params)
    final = np.asarray(render_pipelined(
        scene_f, seed=0, spp=spp, max_depth=depth, rr_depth=4,
        rfilter="box", n_lanes=65536, steps=48, rounds_per_launch=32,
    ))
    write_png(os.path.join(OUT, "flagship_invert_final.png"),
              final)
    out = {
        "workload": {"res": [w, h], "spp": spp, "depth": depth,
                     "tris": 2_000_000, "steps": n_steps},
        "fwdbwd_s_per_step": float(np.mean([c["s"] for c in curve[1:]])),
        "loss_first": curve[0]["loss"], "loss_last": curve[-1]["loss"],
        "rad_err_first": curve[0]["rad_err"],
        "rad_err_last": curve[-1]["rad_err"],
        "col_err_first": curve[0]["col_err"],
        "col_err_last": curve[-1]["col_err"],
        "curve": curve, "total_s": time.perf_counter() - t_all,
        "device": jax.devices()[0].device_kind,
    }
    with open(os.path.join(OUT, "flagship_invert.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("fwdbwd_s_per_step", "loss_first", "loss_last",
                       "rad_err_first", "rad_err_last")}), flush=True)


if __name__ == "__main__":
    main()
