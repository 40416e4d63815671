"""nerad at the FULL reference recipe:
batch 2^14, 1,000 iterations, M=32 RHS fan-out, Adam 1e-3, validation MSE
vs a 1,000-spp path reference (/root/reference/nerad.py:258-259,383-403).
Writes out/nerad_fullrecipe.json (loss/val curve + train-step ms, with the
device) and out/nerad_fullrecipe_{final,ref}.png.

Usage: python scripts/nerad_fullrecipe.py [iters] [batch_pow2] [ref_spp]
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

import jax.numpy as jnp
import numpy as np

from mitsuba3_experiments_tpu.integrators import PathIntegrator, render
from mitsuba3_experiments_tpu.models import (
    FieldConfig,
    HashGridConfig,
    NeradIntegrator,
    NeradTrainer,
)
from mitsuba3_experiments_tpu.scene import cornell_box, load_dict
from mitsuba3_experiments_tpu.utils import mse, write_png


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    batch = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 14)
    ref_spp = int(sys.argv[3]) if len(sys.argv) > 3 else 1000

    scene, _ = load_dict(cornell_box(res=128, spp=1))
    t0 = time.perf_counter()
    ref = np.asarray(render(
        scene, PathIntegrator(max_depth=8, rr_depth=4), spp=ref_spp,
        seed=99,
    ))
    print(f"# {ref_spp}-spp reference: {time.perf_counter()-t0:.1f}s",
          flush=True)

    trainer = NeradTrainer(
        field_cfg=FieldConfig(
            grid=HashGridConfig(n_levels=8, log2_table_size=15,
                                base_resolution=8, finest_resolution=256),
            width=64, depth=4,
        ),
        batch_size=batch, m_rhs=32, lr=1e-3,
    )
    init, step = trainer.make_train_step(scene)
    params, opt_state = init(jax.random.PRNGKey(0))

    # compile + time the steady-state train step
    params, opt_state, loss = step(params, opt_state, jnp.uint32(0))
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for i in range(1, 11):
        params, opt_state, loss = step(params, opt_state, jnp.uint32(i))
    jax.block_until_ready(loss)
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"# train step: {step_ms:.1f} ms (batch {batch}, M=32)",
          flush=True)

    curve = []
    val_every = max(iters // 10, 1)
    t_train = time.perf_counter()
    for i in range(11, iters):
        params, opt_state, loss = step(params, opt_state, jnp.uint32(i))
        if (i + 1) % val_every == 0 or i == iters - 1:
            integ = NeradIntegrator(trainer=trainer, params=params)
            img = np.asarray(render(scene, integ, spp=2))
            v = float(mse(img, ref))
            curve.append({"it": i + 1, "loss": float(loss), "val_mse": v})
            print(f"it {i+1}: loss={float(loss):.5f} val_mse={v:.5f}",
                  flush=True)
    t_train = time.perf_counter() - t_train

    final = np.asarray(render(
        scene, NeradIntegrator(trainer=trainer, params=params), spp=8,
    ))
    out_dir = os.path.join(REPO, "out")
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, "nerad_fullrecipe_final.png"), final)
    write_png(os.path.join(out_dir, "nerad_fullrecipe_ref.png"), ref)
    out = {
        "recipe": {"iters": iters, "batch": batch, "m_rhs": 32,
                   "lr": 1e-3, "ref_spp": ref_spp,
                   "reference": "/root/reference/nerad.py:258-259,383-403"},
        "train_step_ms": step_ms,
        "train_s_total": t_train,
        "final_val_mse_spp8": float(mse(final, ref)),
        "curve": curve,
        "device": jax.devices()[0].device_kind,
    }
    with open(os.path.join(out_dir, "nerad_fullrecipe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"train_step_ms": step_ms,
                      "final_val_mse": out["final_val_mse_spp8"],
                      "curve_tail": curve[-3:]}))


if __name__ == "__main__":
    main()
