"""BDPT and SPPM demonstration: equal-budget
MSE against the unidirectional path tracer on a caustic-heavy scene.

Scene: glass sphere over a diffuse floor under a small bright area light
(the PSSMLT caustic scene, examples/run_pssmlt.py) — the transport the
reference's scripts target: /root/reference/bdpt02.py:276-290 renders its
BDPT against this class of scene, and sppm.py:236-274 is built for exactly
the specular-caustic photon regime (its photon pass is the literal `...`
the repo's SPPM completes).

Protocol (equal wall-clock budget on the device it runs on):
  1. reference: path tracer at high spp (default 4096).
  2. path at `budget_spp`, timed -> T_budget.
  3. BDPT (full (s,t) MIS) with spp chosen to spend ~T_budget.
  4. SPPM progressive frames until ~T_budget.
MSE is reported full-frame and over the caustic crop (the bright floor
region under the sphere) where bidirectional/photon methods should win.

Usage: python examples/bdpt_sppm_eval.py [res] [budget_spp] [ref_spp]
Artifacts: artifacts/bdpt_sppm_{ref,path,bdpt,sppm}.png + metrics JSON.
"""
import json
import os
import sys
import time

import _common  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba3_experiments_tpu.integrators import (
    BDPTIntegrator,
    PathIntegrator,
    SPPM,
    render,
)
from mitsuba3_experiments_tpu.core import math as cmath
from mitsuba3_experiments_tpu.scene import load_dict
from mitsuba3_experiments_tpu.scene import mesh as meshlib
from mitsuba3_experiments_tpu.utils import write_png


def caustic_scene(res: int) -> dict:
    """Glass sphere over a diffuse floor, small bright area light (the
    examples/run_pssmlt.py hard-transport scene, inlined — importing that
    script would execute its render)."""
    sph = meshlib.sphere(radius=0.5, n_theta=24, n_phi=48)
    floor = meshlib.rectangle(subdiv=8)
    light = meshlib.rectangle(subdiv=1)
    fv = (floor.vertices * 4.0) @ np.array(
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32
    )
    lv = light.vertices * 0.15 @ np.array(
        [[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32
    ) + np.array([1.2, 2.5, 1.2], np.float32)
    return {
        "type": "scene",
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": cmath.look_at([0, 2.2, 4.5], [0, 0.4, 0],
                                      [0, 1, 0]),
            "film": {"width": res, "height": res},
        },
        "ball": {
            "type": "mesh",
            "vertices": sph.vertices + np.array([0, 0.8, 0], np.float32),
            "faces": sph.faces,
            "bsdf": {"type": "dielectric", "int_ior": 1.5},
        },
        "floor": {
            "type": "mesh", "vertices": fv, "faces": floor.faces,
            "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.55, 0.5]},
        },
        "light": {
            "type": "mesh", "vertices": lv, "faces": light.faces,
            "bsdf": {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]},
            "emitter": {"type": "area", "radiance": [400.0, 380.0, 350.0]},
        },
    }

res = int(sys.argv[1]) if len(sys.argv) > 1 else 256
budget_spp = int(sys.argv[2]) if len(sys.argv) > 2 else 64
ref_spp = int(sys.argv[3]) if len(sys.argv) > 3 else 2048
DEPTH = 8
CHUNK = None   # whole-wavefront launches; set a lane count to bound memory

scene, _ = load_dict(caustic_scene(res))
os.makedirs("artifacts", exist_ok=True)


def tonemap(x):
    return np.clip(np.asarray(x) ** (1 / 2.2), 0, 1)


def mse(a, b, mask=None):
    d = (np.asarray(a) - np.asarray(b)) ** 2
    if mask is not None:
        d = d[mask]
    return float(d.mean())


def rel_mse(a, ref, mask=None):
    a, ref = np.asarray(a), np.asarray(ref)
    d = (a - ref) ** 2 / (ref**2 + 1e-2)
    if mask is not None:
        d = d[mask]
    return float(d.mean())


print("rendering reference...", flush=True)
ref = np.asarray(
    render(scene, PathIntegrator(max_depth=DEPTH, rr_depth=5),
           spp=ref_spp, seed=777, chunk=CHUNK)
)
write_png("artifacts/bdpt_sppm_ref.png", tonemap(ref))

# caustic crop: bright floor pixels (reference luminance above median,
# lower half of the frame where the refracted light pools)
lum = ref.mean(-1)
floor = np.zeros_like(lum, bool)
floor[res // 2:] = True
caustic_mask = floor & (lum > np.median(lum[floor]) * 1.5)
print(f"caustic crop: {caustic_mask.mean()*100:.1f}% of pixels", flush=True)

metrics = {"res": res, "depth": DEPTH, "ref_spp": ref_spp,
           "budget_spp": budget_spp,
           "device": str(jax.devices()[0]), "methods": {}}

# ---- path at budget ----
pt = PathIntegrator(max_depth=DEPTH, rr_depth=5)
img = render(scene, pt, spp=budget_spp, seed=3, chunk=CHUNK)  # warm
jax.block_until_ready(img)
t0 = time.time()
img_path = render(scene, pt, spp=budget_spp, seed=11, chunk=CHUNK)
jax.block_until_ready(img_path)
t_budget = time.time() - t0
write_png("artifacts/bdpt_sppm_path.png", tonemap(img_path))
metrics["methods"]["path"] = {
    "spp": budget_spp, "seconds": t_budget,
    "mse": mse(img_path, ref), "rel_mse": rel_mse(img_path, ref),
    "mse_caustic": mse(img_path, ref, caustic_mask),
    "rel_mse_caustic": rel_mse(img_path, ref, caustic_mask),
}
print(f"path {budget_spp}spp: {t_budget:.1f}s "
      f"mse={metrics['methods']['path']['mse']:.4g} "
      f"caustic={metrics['methods']['path']['mse_caustic']:.4g}",
      flush=True)

# ---- BDPT at equal budget ----
bd = BDPTIntegrator(max_depth=DEPTH, mis=True)
probe_spp = max(budget_spp // 8, 4)
img = render(scene, bd, spp=probe_spp, seed=3, chunk=CHUNK)
jax.block_until_ready(img)
t0 = time.time()
img = render(scene, bd, spp=probe_spp, seed=4, chunk=CHUNK)
jax.block_until_ready(img)
t_probe = time.time() - t0
bdpt_spp = max(4, int(probe_spp * t_budget / t_probe / 4) * 4)
print(f"bdpt probe {probe_spp}spp took {t_probe:.1f}s -> "
      f"using {bdpt_spp}spp", flush=True)
img = render(scene, bd, spp=bdpt_spp, seed=3, chunk=CHUNK)
jax.block_until_ready(img)
t0 = time.time()
img_bdpt = render(scene, bd, spp=bdpt_spp, seed=21, chunk=CHUNK)
jax.block_until_ready(img_bdpt)
t_bdpt = time.time() - t0
write_png("artifacts/bdpt_sppm_bdpt.png", tonemap(img_bdpt))
metrics["methods"]["bdpt"] = {
    "spp": bdpt_spp, "seconds": t_bdpt,
    "mse": mse(img_bdpt, ref), "rel_mse": rel_mse(img_bdpt, ref),
    "mse_caustic": mse(img_bdpt, ref, caustic_mask),
    "rel_mse_caustic": rel_mse(img_bdpt, ref, caustic_mask),
}
print(f"bdpt {bdpt_spp}spp: {t_bdpt:.1f}s "
      f"mse={metrics['methods']['bdpt']['mse']:.4g} "
      f"caustic={metrics['methods']['bdpt']['mse_caustic']:.4g}",
      flush=True)

# ---- SPPM at equal budget ----
integ = SPPM(max_depth=DEPTH, photon_count=1 << 18, initial_radius=0.02,
             max_per_cell=64, grid_cells=1 << 18)
state = integ.init_state(scene)
step = jax.jit(lambda st, s: integ.render_frame(scene, st, s))
img, state = step(state, jnp.uint32(0))
jax.block_until_ready(img)
t0 = time.time()
frames = 1
while time.time() - t0 < t_budget:
    img, state = step(state, jnp.uint32(frames))
    # block per frame: async dispatch would otherwise enqueue hundreds
    # of frames inside the budget window before the first completes
    jax.block_until_ready(img)
    frames += 1
t_sppm = time.time() - t0
img_sppm = np.asarray(img).reshape(res, res, 3)
write_png("artifacts/bdpt_sppm_sppm.png", tonemap(img_sppm))
metrics["methods"]["sppm"] = {
    "frames": frames, "photons_per_frame": integ.photon_count,
    "seconds": t_sppm,
    "mse": mse(img_sppm, ref), "rel_mse": rel_mse(img_sppm, ref),
    "mse_caustic": mse(img_sppm, ref, caustic_mask),
    "rel_mse_caustic": rel_mse(img_sppm, ref, caustic_mask),
}
print(f"sppm {frames} frames: {t_sppm:.1f}s "
      f"mse={metrics['methods']['sppm']['mse']:.4g} "
      f"caustic={metrics['methods']['sppm']['mse_caustic']:.4g}",
      flush=True)

with open("artifacts/bdpt_sppm_metrics.json", "w") as f:
    json.dump(metrics, f, indent=1)
print("wrote artifacts/bdpt_sppm_{ref,path,bdpt,sppm}.png + metrics")


# ---- scene 2: occluded light (BDPT's win case) ----
# hidden-light cornell (panel tucked behind the tall box,
# tests/test_bdpt_sppm.py): NEE is occluded almost everywhere, so
# camera-only sampling struggles while light subpaths carry illumination
# out and connect — /root/reference/bdpt02.py's motivating transport.
from mitsuba3_experiments_tpu.core import math as cm
from mitsuba3_experiments_tpu.scene import cornell_box

d = cornell_box(res=res, spp=1)
d["light"]["to_world"] = cm.matmul4(
    cm.translate([-0.85, -0.5, -0.55]),
    cm.rotate([0, 1, 0], 90),
    cm.scale_mat([0.25, 0.25, 1.0]),
)
scene2, _ = load_dict(d)
print("rendering occluded-light reference...", flush=True)
ref2 = np.asarray(render(
    scene2, PathIntegrator(max_depth=DEPTH, rr_depth=99),
    spp=ref_spp, seed=77, chunk=CHUNK,
))
write_png("artifacts/bdpt_occluded_ref.png", tonemap(ref2))

pt2 = PathIntegrator(max_depth=DEPTH, rr_depth=99)
img = render(scene2, pt2, spp=budget_spp, seed=3, chunk=CHUNK)
jax.block_until_ready(img)
t0 = time.time()
img_p2 = render(scene2, pt2, spp=budget_spp, seed=12, chunk=CHUNK)
jax.block_until_ready(img_p2)
t_p2 = time.time() - t0
write_png("artifacts/bdpt_occluded_path.png", tonemap(img_p2))

bd2 = BDPTIntegrator(max_depth=DEPTH, mis=True)
img = render(scene2, bd2, spp=probe_spp, seed=3, chunk=CHUNK)
jax.block_until_ready(img)
t0 = time.time()
img = render(scene2, bd2, spp=probe_spp, seed=4, chunk=CHUNK)
jax.block_until_ready(img)
t_pr2 = time.time() - t0
b2_spp = max(4, int(probe_spp * t_p2 / t_pr2 / 4) * 4)
img = render(scene2, bd2, spp=b2_spp, seed=3, chunk=CHUNK)
jax.block_until_ready(img)
t0 = time.time()
img_b2 = render(scene2, bd2, spp=b2_spp, seed=22, chunk=CHUNK)
jax.block_until_ready(img_b2)
t_b2 = time.time() - t0
write_png("artifacts/bdpt_occluded_bdpt.png", tonemap(img_b2))

metrics["occluded"] = {
    "path": {"spp": budget_spp, "seconds": t_p2,
             "mse": mse(img_p2, ref2), "rel_mse": rel_mse(img_p2, ref2),
             "medae": float(np.median(np.abs(np.asarray(img_p2) - ref2)))},
    "bdpt": {"spp": b2_spp, "seconds": t_b2,
             "mse": mse(img_b2, ref2), "rel_mse": rel_mse(img_b2, ref2),
             "medae": float(np.median(np.abs(np.asarray(img_b2) - ref2)))},
}
print(f"occluded path {budget_spp}spp {t_p2:.1f}s: "
      f"mse={metrics['occluded']['path']['mse']:.4g} "
      f"medae={metrics['occluded']['path']['medae']:.4g}", flush=True)
print(f"occluded bdpt {b2_spp}spp {t_b2:.1f}s: "
      f"mse={metrics['occluded']['bdpt']['mse']:.4g} "
      f"medae={metrics['occluded']['bdpt']['medae']:.4g}", flush=True)
with open("artifacts/bdpt_sppm_metrics.json", "w") as f:
    json.dump(metrics, f, indent=1)
print("wrote occluded-light artifacts + merged metrics")
