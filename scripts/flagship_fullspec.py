"""Render the flagship at the REFERENCE spec and save the artifact.

The bedroom scene.xml defines the north-star workload (SURVEY.md section 6:
1280x720, spp 64, max_depth 65, independent sampler, tent filter —
/root/reference/data/bedroom/scene.xml:2-6) on the seeded bedroom-class
scene.  bench.py runs depth 8 and 65 at spp 4; this script runs the full
spec once on the GPU, prints rays/s with the device it ran on, and writes
PNG + EXR + JSON to out/.

Usage: python scripts/flagship_fullspec.py [spp] [depth]
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

from mitsuba3_experiments_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from mitsuba3_experiments_tpu.integrators.pipelined import render_pipelined
from mitsuba3_experiments_tpu.scene.flagship import load_flagship
from mitsuba3_experiments_tpu.utils.image import write_exr, write_png

spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
depth = int(sys.argv[2]) if len(sys.argv) > 2 else 65

dev = jax.devices()[0]
if dev.platform != "gpu":
    sys.exit(f"needs a GPU, found {dev.platform}")
print("device:", dev.device_kind, flush=True)
scene, _ = load_flagship(res=(1280, 720), spp=spp, tri_budget=2_000_000)
n_rays = 1280 * 720 * spp

# scatter retire, steps=48: the deep spp-64 frame has G=450 generations,
# where the dense generation-indexed retire keeps a (G, S, N, 3) buffer
# (hypothesis to re-measure on the GPU: ROADMAP queue 1, item 4)
kw = dict(spp=spp, max_depth=depth, rr_depth=4, rfilter="tent",
          n_lanes=65536, steps=48, rounds_per_launch=32,
          retire="scatter")
t0 = time.perf_counter()
img = np.asarray(render_pipelined(scene, seed=0, **kw))
dt = time.perf_counter() - t0
print(f"spp {spp} depth {depth}: {dt:.1f}s = {n_rays/dt:.0f} rays/s "
      f"(incl. compile), mean {img.mean():.4f}, nan {np.isnan(img).sum()}",
      flush=True)

out = os.path.join(REPO, "out")
os.makedirs(out, exist_ok=True)
tag = f"flagship_spp{spp}_d{depth}"
write_exr(os.path.join(out, tag + ".exr"), img)
write_png(os.path.join(out, tag + ".png"), img)
with open(os.path.join(out, tag + ".json"), "w") as f:
    json.dump({"spp": spp, "depth": depth, "seconds": dt,
               "rays_per_s_incl_compile": n_rays / dt,
               "mean": float(img.mean()), "device": dev.device_kind}, f)
print("artifacts written:", tag, flush=True)
