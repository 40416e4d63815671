"""ReSTIR GI A/B evaluation harness — the analog of
/root/reference/test-restir-spatial.py / test-restir-jacobian.py /
test-restir-spatial-spatial.py / test-restir-dynamic.py: run N frames per
config pair, record per-frame bias / variance / MSE against a high-spp path
reference, write curves to JSON and frame strips to PNG.

Usage: python examples/restir_eval.py [mode] [frames] [res] [chunk] [scene]
  mode in {spatial, jacobian, spatial_spatial, dynamic}
  chunk > 0 switches to banded render_frame_chunked launches (bounded
  per-launch memory at the reference-scale 1024^2,
  test-restir-spatial.py:11-17).
  scene in {cornell, sphere}: `sphere` adds a large diffuse sphere close to
  the left wall — curved close-range geometry where neighbor reconnection
  Jacobians deviate from 1, so the jacobian/bias-correction flags have a
  visible effect (on the flat cornell box their A/B deltas sit in noise).

Metrics per frame: mean bias (the reference's metric), variance, MSE, and
`mabs_bias` — mean |running-average image − ref|, which isolates estimator
bias from per-frame noise instead of letting signed bias cancel across
pixels.
"""
import dataclasses
import json
import os
import sys

import _common  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba3_experiments_tpu.integrators.persistent import render_persistent
from mitsuba3_experiments_tpu.integrators.restir import RestirGI
from mitsuba3_experiments_tpu.scene import cornell_box, load_dict
from mitsuba3_experiments_tpu.utils import write_png

mode = sys.argv[1] if len(sys.argv) > 1 else "spatial"
n_frames = int(sys.argv[2]) if len(sys.argv) > 2 else 100
res = int(sys.argv[3]) if len(sys.argv) > 3 else 256
chunk = int(sys.argv[4]) if len(sys.argv) > 4 else 0
scene_name = sys.argv[5] if len(sys.argv) > 5 else "cornell"

CONFIG_PAIRS = {
    # test-restir-spatial.py:27-47: bias correction on/off
    "spatial": [
        {"bias_correction": True, "jacobian": True},
        {"bias_correction": False, "jacobian": True},
    ],
    # test-restir-jacobian.py: jacobian on/off
    "jacobian": [
        {"bias_correction": True, "jacobian": True},
        {"bias_correction": True, "jacobian": False},
    ],
    # test-restir-spatial-spatial.py: spatial-spatial reuse on/off
    "spatial_spatial": [
        {"spatial_spatial_reuse": True},
        {"spatial_spatial_reuse": False},
    ],
    # test-restir-dynamic.py: translating camera
    "dynamic": [{}],
}

d = cornell_box(res=res, spp=1)
if scene_name == "sphere":
    from mitsuba3_experiments_tpu.scene import mesh as meshlib

    sph = meshlib.sphere(
        center=(-0.45, -0.45, 0.1), radius=0.52, n_theta=48, n_phi=96
    )
    d["sphere"] = {
        "type": "mesh", "vertices": np.asarray(sph.vertices),
        "faces": np.asarray(sph.faces), "normals": np.asarray(sph.normals),
        "bsdf": {"type": "ref", "id": "white"},
    }
scene, _ = load_dict(d)

# the 256-spp reference dominates wall time at 1024^2 — render it once per
# resolution via the persistent renderer (equality-tested vs render()) and
# cache to disk so every mode reuses it
os.makedirs("out", exist_ok=True)
ref_path = (
    f"out/restir_ref_{res}.npy" if scene_name == "cornell"
    else f"out/restir_ref_{scene_name}_{res}.npy"
)
try:
    if mode == "dynamic":
        # dynamic mode renders a per-frame reference inside the loop; the
        # static cached reference would never be used
        ref = np.zeros((res, res, 3), np.float32)
    else:
        ref = np.load(ref_path)
        print(f"reference: loaded {ref_path}")
except FileNotFoundError:
    print("reference render (256 spp)...")
    ref = np.asarray(render_persistent(
        scene, spp=256, max_depth=8, rr_depth=2,
        n_lanes=32768, rounds_per_launch=32,
    ))
    np.save(ref_path, ref)

results = {}
for ci, overrides in enumerate(CONFIG_PAIRS[mode]):
    integ = RestirGI(max_depth=8, rr_depth=2, **overrides)
    state = integ.init_state(scene)
    if chunk:
        def frame_fn(sc, st, s, integ=integ):
            return integ.render_frame_chunked(sc, st, s, chunk=chunk)
    else:
        frame_fn = jax.jit(lambda sc, st, s: integ.render_frame(sc, st, s))
    bias, var, mse_curve, mabs = [], [], [], []
    avg = np.zeros_like(ref)
    cur_scene = scene
    for i in range(n_frames):
        if mode == "dynamic":
            cam = cur_scene.camera
            cur_scene = dataclasses.replace(
                cur_scene,
                camera=dataclasses.replace(
                    cam, to_world=cam.to_world.at[0, 3].add(0.005)
                ),
            )
        img, state = frame_fn(cur_scene, state, jnp.uint32(i))
        if mode == "dynamic":
            # the camera moves every frame: a static cached reference would
            # measure scene divergence, not estimator error — render a
            # moderate-spp per-frame reference instead (RESTIR_DYN_REF_SPP
            # env; the per-frame reference dominates wall time at 1024^2)
            dyn_spp = int(os.environ.get("RESTIR_DYN_REF_SPP", "64"))
            ref = np.asarray(render_persistent(
                cur_scene, spp=dyn_spp, max_depth=8, rr_depth=2,
                n_lanes=32768, rounds_per_launch=32,
            ))
        diff = np.asarray(img) - ref
        bias.append(float(diff.mean()))
        var.append(float(np.asarray(img).var()))
        mse_curve.append(float((diff**2).mean()))
        if mode == "dynamic":
            # per-frame MAE (running-mean bias is meaningless when the
            # camera moves)
            mabs.append(float(np.abs(diff).mean()))
        else:
            avg += (np.asarray(img) - avg) / (i + 1)
            mabs.append(float(np.abs(avg - ref).mean()))
        if i % 20 == 0:
            print(f"  config {ci} frame {i}: mse={mse_curve[-1]:.4f} "
                  f"mabs_bias={mabs[-1]:.4f}")
    results[f"config{ci}_{json.dumps(overrides)}"] = {
        "bias": bias, "variance": var, "mse": mse_curve,
        "mabs_bias": mabs,
    }
    tag = mode if scene_name == "cornell" else f"{mode}_{scene_name}"
    write_png(f"out/restir_{tag}_{ci}.png", np.asarray(img))

tag = mode if scene_name == "cornell" else f"{mode}_{scene_name}"
with open(f"out/restir_{tag}_metrics.json", "w") as f:
    json.dump(results, f, indent=1)
print(f"wrote out/restir_{tag}_metrics.json")
